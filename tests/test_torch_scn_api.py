"""The port's SCN layer API (uresnet_pytorch_tpu_torch/scn.py and
ops/pooling.py) against the reference's (uresnet_pytorch_tpu/scn.py).

The eight oracle tests of tests/test_scn_api.py (nine cases) run on the
port's layers: dense equivalence on fully active grids, sites restored by
the way back, the tables, the surface's tail. Each also runs the
reference's flax net of the same layers, carries its parameters into the
port's (`utils/weights.load_flax_compact`) and holds every output to it:
f32 values to 1e-5 (relative to the output's largest), integer sites
(keys, counts) bitwise. Then: the pooling functions and their gradients
against `jax.vjp` (max pooling on tied children included), and train-mode
BN with a small 3D net's parameter gradients against the reference's.
Every size is at most a few hundred sites.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from uresnet_pytorch_tpu import scn as jscn
from uresnet_pytorch_tpu.ops import pooling as jpool
from uresnet_pytorch_tpu_torch import scn
from uresnet_pytorch_tpu_torch.models.norm import commit_batch_moments
from uresnet_pytorch_tpu_torch.ops import pooling as tpool
from uresnet_pytorch_tpu_torch.ops.coords import encode
from uresnet_pytorch_tpu_torch.ops.sparse_graph import downsample_link
from uresnet_pytorch_tpu_torch.utils.weights import (_flax_names,
                                                     export_variables,
                                                     load_flax_compact)
from tests.test_torch_model import one_torch_thread  # noqa: F401


def _full_grid_blob(S, dim, seed=0):
    """Fully active S^dim grid as a blob (1 event), raster order."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*([np.arange(S)] * dim), indexing="ij"),
                 -1).reshape(-1, dim).astype(np.int32)
    n = len(g)
    values = rng.normal(size=n).astype(np.float32)
    return g[None], values[None], np.array([n], np.int32)


def _sparse_blob(S, dim, n, seed):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*([np.arange(S)] * dim), indexing="ij"),
                 -1).reshape(-1, dim)
    sel = rng.choice(len(g), n, replace=False)
    return (g[sel][None].astype(np.int32),
            rng.normal(size=n).astype(np.float32)[None],
            np.array([n], np.int32))


def _run(jnet, tnet, *args, seed=0):
    """The reference net's variables and output on args, and the port
    net's output from the same parameters (numpy in, torch out). The
    reference runs jitted: one compile, not one per op."""
    v = jax.jit(jnet.init)(jax.random.PRNGKey(seed), *args)
    jout = jax.jit(jnet.apply)(v, *args)
    load_flax_compact(tnet, v)
    tout = tnet(*[torch.from_numpy(np.asarray(a)) for a in args])
    return v, jout, tout


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1))


def _same_tensor(tst, jst):
    """A port SparseTensor against the reference's: sites bitwise, the
    active rows' features to 1e-5."""
    np.testing.assert_array_equal(tst.num.numpy(), np.asarray(jst.num))
    np.testing.assert_array_equal(tst.keys.numpy(), np.asarray(jst.keys))
    assert tst.spatial_size == jst.spatial_size
    n = int(jst.num[0])
    _close(tst.features[:, :n], np.asarray(jst.features)[:, :n])


# ---------------------------------------------------------------------------
# the reference's oracles, on the port's layers
# ---------------------------------------------------------------------------

def test_submanifold_conv_matches_dense_2d():
    S, dim = 8, 2
    coords, values, n = _full_grid_blob(S, dim)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, roi = jscn.InputLayer(dim, S)(coords, values, n)
            st = jscn.SubmanifoldConvolution(dim, 4)(st)
            return jscn.OutputLayer(dim)(st, roi)

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.conv = scn.SubmanifoldConvolution(dim, 1, 4)
            self.out = scn.OutputLayer(dim)

        def forward(self, coords, values, n):
            st, roi = self.inp(coords, values, n)
            return self.out(self.conv(st), roi)

    tnet = TNet()
    _, jout, out = _run(JNet(), tnet, coords, values, n)
    _close(out, jout)
    w = tnet.conv.w.detach()                              # (9, 1, 4)
    dense = F.conv2d(torch.from_numpy(values).view(1, 1, S, S),
                     w.view(3, 3, 1, 4).permute(3, 2, 0, 1), padding=1)
    # blob rows are raster order (meshgrid ij), the dense layout's
    np.testing.assert_allclose(out.detach().numpy().reshape(S, S, 4),
                               dense[0].permute(1, 2, 0).numpy(), atol=1e-4)


@pytest.mark.parametrize("pool,reducer", [
    ("max", lambda v: v.max(axis=(1, 3))),
    ("avg", lambda v: v.mean(axis=(1, 3)))])
def test_pooling_matches_dense_2d(pool, reducer):
    S, dim = 8, 2
    coords, values, n = _full_grid_blob(S, dim)
    jpool_cls = jscn.MaxPooling if pool == "max" else jscn.AveragePooling
    tpool_cls = scn.MaxPooling if pool == "max" else scn.AveragePooling

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, _ = jscn.InputLayer(dim, S)(coords, values, n)
            return jpool_cls(dim)(st)

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.pool = tpool_cls(dim)                  # volume mode

        def forward(self, coords, values, n):
            return self.pool(self.inp(coords, values, n)[0])

    _, (jst, jlink), (stc, link) = _run(JNet(), TNet(), coords, values, n)
    _same_tensor(stc, jst)
    for name in ("parent", "corner", "keys_f", "num_f"):
        np.testing.assert_array_equal(getattr(link, name).numpy(),
                                      np.asarray(getattr(jlink, name)))
    assert link.cap_c == jlink.cap_c
    # coarse keys are the S/2 grid's raster order on a full grid
    expect = reducer(values.reshape(S // 2, 2, S // 2, 2)).reshape(-1)
    got = stc.features[0, :int(stc.num[0]), 0].numpy()
    np.testing.assert_allclose(got, expect, atol=1e-5)
    assert int(stc.num[0]) == (S // 2) ** 2


def test_unpooling_roundtrip_and_residual_tables():
    S, dim = 8, 3
    coords, values, n = _sparse_blob(S, dim, 100, seed=4)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, _ = jscn.InputLayer(dim, S)(coords, values, n)
            keep = jscn.SubmanifoldConvolution(dim, 3)(st)
            stc, link = jscn.MaxPooling(dim)(keep)
            stu = jscn.UnPooling(dim)(stc, link)
            return jscn.add_table(jscn.join_table(stu, keep),
                                  jscn.join_table(keep, stu)), keep

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.conv = scn.SubmanifoldConvolution(dim, 1, 3)
            self.pool = scn.MaxPooling(dim)
            self.unpool = scn.UnPooling(dim)

        def forward(self, coords, values, n):
            keep = self.conv(self.inp(coords, values, n)[0])
            stu = self.unpool(*self.pool(keep))
            return scn.add_table(scn.join_table(stu, keep),
                                 scn.join_table(keep, stu)), keep

    _, (jst2, jkeep), (st2, keep) = _run(JNet(), TNet(), coords, values, n,
                                         seed=1)
    _same_tensor(st2, jst2)
    assert st2.features.shape[-1] == 6
    np.testing.assert_array_equal(st2.keys.numpy(), keep.keys.numpy())
    assert torch.isfinite(st2.features).all()


def test_conv_deconv_restores_sites_3d():
    S, dim = 8, 3
    coords, values, n = _sparse_blob(S, dim, 60, seed=9)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, _ = jscn.InputLayer(dim, S)(coords, values, n)
            st = jscn.SubmanifoldConvolution(dim, 2)(st)
            stc, link = jscn.Convolution(dim, 4)(st)
            stf = jscn.Deconvolution(dim, 2)(stc, link)
            stf = jscn.BatchNormLeakyReLU(leakiness=0.1)(stf, train=False)
            return st, stc, stf

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.conv = scn.SubmanifoldConvolution(dim, 1, 2)
            self.down = scn.Convolution(dim, 2, 4)
            self.up = scn.Deconvolution(dim, 4, 2)
            self.bn = scn.BatchNormLeakyReLU(2, leakiness=0.1)

        def forward(self, coords, values, n):
            st = self.conv(self.inp(coords, values, n)[0])
            stc, link = self.down(st)
            return st, stc, self.bn(self.up(stc, link), train=False)

    _, jouts, outs = _run(JNet(), TNet(), coords, values, n, seed=2)
    for got, want in zip(outs, jouts):
        _same_tensor(got, want)
    st, stc, stf = outs
    np.testing.assert_array_equal(stf.keys.numpy(), st.keys.numpy())
    assert int(stc.num[0]) <= int(st.num[0])
    assert stf.spatial_size == S and stc.spatial_size == S // 2


def test_full_convolution_activates_children_2d():
    """Every child of an active coarse site is active; the dense oracle is
    the stride-2 transposed conv on the dense grid."""
    S, dim = 4, 2
    coords, values, n = _full_grid_blob(S, dim, seed=3)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, _ = jscn.InputLayer(dim, S)(coords, values, n)
            return jscn.SparseToDense(dim)(jscn.FullConvolution(dim, 3)(st))

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.full = scn.FullConvolution(dim, 1, 3)
            self.dense = scn.SparseToDense(dim)

        def forward(self, coords, values, n):
            return self.dense(self.full(self.inp(coords, values, n)[0]))

    tnet = TNet()
    _, jout, out = _run(JNet(), tnet, coords, values, n, seed=1)
    _close(out, jout)
    out = out.detach().numpy()
    assert out.shape == (1, 2 * S, 2 * S, 3)
    w = tnet.full.w.detach().numpy()                      # (4, 1, 3)
    dense_in = np.zeros((S, S))
    dense_in[coords[0, :, 0], coords[0, :, 1]] = values[0]
    ref = np.zeros((2 * S, 2 * S, 3))
    for o in range(4):
        ref[(o >> 1) & 1::2, o & 1::2, :] += dense_in[..., None] * w[o, 0]
    np.testing.assert_allclose(out[0], ref, atol=1e-5)


def test_sparse_to_dense_3d():
    S, dim = 4, 3
    coords, values, n = _full_grid_blob(S, dim, seed=5)
    keep = np.arange(0, S ** dim, 2)      # half the sites: truly sparse
    coords, values = coords[:, keep], values[:, keep]
    n = np.array([len(keep)], np.int32)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, _ = jscn.InputLayer(dim, S)(coords, values, n)
            return jscn.SparseToDense(dim)(st)

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.dense = scn.SparseToDense(dim)

        def forward(self, coords, values, n):
            return self.dense(self.inp(coords, values, n)[0])

    _, jout, out = _run(JNet(), TNet(), coords, values, n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    ref = np.zeros((S, S, S, 1), np.float32)
    ref[coords[0, :, 0], coords[0, :, 1], coords[0, :, 2], 0] = values[0]
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-6)


def test_bl_input_layer_multichannel_merge():
    """BLInputLayer merges duplicate coordinates per channel (sum mode)."""
    dim, S = 2, 8
    coords = np.array([[[1, 1], [2, 3], [1, 1], [4, 4]]], np.int32)
    feats = np.array([[[1., 10.], [2., 20.], [3., 30.], [4., 40.]]],
                     np.float32)
    n = np.array([4], np.int32)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, c, f, n):
            st, roi = jscn.BLInputLayer(dim, S)(c, f, n)
            return jscn.OutputLayer(dim)(st, roi)

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.BLInputLayer(dim, S)
            self.out = scn.OutputLayer(dim)

        def forward(self, c, f, n):
            return self.out(*self.inp(c, f, n))

    _, jout, out = _run(JNet(), TNet(), coords, feats, n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    out = out.numpy()
    # rows 0 and 2 share (1,1): both report the merged sum (4, 40)
    np.testing.assert_allclose(out[0, 0], [4., 40.], atol=1e-6)
    np.testing.assert_allclose(out[0, 2], [4., 40.], atol=1e-6)
    np.testing.assert_allclose(out[0, 1], [2., 20.], atol=1e-6)


@pytest.mark.parametrize("residual", [False, True])
def test_fcn_shapes_and_submanifold_invariant(residual):
    """FCN: the output joins every level's planes at full resolution;
    inactive sites stay exactly zero. With residual blocks, level 1 (whose
    width the stride-2 conv already set) takes the residual path."""
    S, dim = 8, 2
    rng = np.random.default_rng(9)
    pts = rng.choice(S * S, size=20, replace=False)
    coords = np.stack([pts // S, pts % S], -1).astype(np.int32)[None]
    values = rng.normal(size=20).astype(np.float32)[None]
    n = np.array([20], np.int32)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, c, v, nn_):
            st, roi = jscn.InputLayer(dim, S)(c, v, nn_)
            st = jscn.FullyConvolutionalNet(
                dim, reps=1, nPlanes=(4, 8), residual_blocks=residual)(st)
            return jscn.OutputLayer(dim)(st, roi)

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.fcn = scn.FullyConvolutionalNet(dim, 1, reps=1,
                                                 nPlanes=(4, 8),
                                                 residual_blocks=residual)
            self.out = scn.OutputLayer(dim)

        def forward(self, c, v, nn_):
            st, roi = self.inp(c, v, nn_)
            return self.out(self.fcn(st), roi)

    _, jout, out = _run(JNet(), TNet(), coords, values, n, seed=2)
    _close(out, jout)
    assert out.shape == (1, coords.shape[1], 12)   # 4 + 8 joined
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# pooling functions and gradients; training
# ---------------------------------------------------------------------------

def _pool_case(seed):
    """Fine features with ties: 3 events' rows on a sparse 3D grid, values
    rounded to a few levels so several children share a cell's max; one
    event short (padding rows) and a small coarse capacity (dropped
    parents)."""
    S, dim, V = 8, 3, 64
    rng = np.random.default_rng(seed)
    cap_c = 20
    coords = np.zeros((3, V, dim), np.int32)
    num = np.array([V, V - 10, V], np.int32)
    for b in range(3):
        g = np.stack(np.meshgrid(*([np.arange(S)] * dim), indexing="ij"),
                     -1).reshape(-1, dim)
        coords[b] = g[np.sort(rng.choice(len(g), V, replace=False))]
    valid = torch.arange(V)[None] < torch.from_numpy(num)[:, None]
    keys = torch.sort(encode(torch.from_numpy(coords), valid, S), 1)[0]
    _, _, parent, _, _ = downsample_link(keys, S, dim, cap_c)
    feats = np.round(rng.normal(size=(3, V, 5)) * 2) / 2
    return feats.astype(np.float32), parent.numpy(), num, cap_c, dim


@pytest.mark.parametrize("fn", ["max", "avg_volume", "avg_active", "unpool"])
def test_pooling_ops_and_gradients_match_reference(fn):
    """Each pooling op and its gradient against `jax.vjp` of the
    reference's, on rows with ties (max: the gradient at children tied for
    a cell's maximum is split evenly in both), padding and dropped
    parents."""
    feats, parent, num, cap_c, dim = _pool_case(seed=3)
    if fn == "unpool":
        x = np.random.default_rng(1).normal(size=(3, cap_c, 5)).astype(
            np.float32)
        jf = lambda f: jpool.unpool(f, jnp.asarray(parent), cap_c)  # noqa
        tf = lambda f: tpool.unpool(f, torch.from_numpy(parent), cap_c)  # noqa
    else:
        x = feats
        args = (jnp.asarray(parent), jnp.asarray(num), cap_c)
        targs = (torch.from_numpy(parent), torch.from_numpy(num), cap_c)
        if fn == "max":
            jf = lambda f: jpool.max_pool(f, *args)  # noqa
            tf = lambda f: tpool.max_pool(f, *targs)  # noqa
        else:
            mode = fn.split("_")[1]
            jf = lambda f: jpool.avg_pool(f, *args, dim, mode)  # noqa
            tf = lambda f: tpool.avg_pool(f, *targs, dim, mode)  # noqa
    ref, vjp = jax.vjp(jf, jnp.asarray(x))
    ct = np.random.default_rng(2).normal(size=ref.shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tf(tx)
    out.backward(torch.from_numpy(ct))
    _close(out, ref)
    _close(tx.grad, ref_dx)


def test_max_pool_gradient_splits_ties_evenly():
    """Two children tied for a cell's maximum take half of its gradient
    each, in the reference and the port; a dropped row takes none."""
    feats = np.array([[[1., 2.], [1., 5.], [3., 5.], [3., 0.], [7., 7.]]],
                     np.float32)
    parent = np.array([[0, 0, 0, 1, 2]], np.int32)     # row 4 dropped
    num = np.array([5], np.int32)
    g = np.array([[[1., 2.], [3., 4.]]], np.float32)
    ref, vjp = jax.vjp(lambda f: jpool.max_pool(
        f, jnp.asarray(parent), jnp.asarray(num), 2), jnp.asarray(feats))
    tx = torch.from_numpy(feats).requires_grad_(True)
    out = tpool.max_pool(tx, torch.from_numpy(parent),
                         torch.from_numpy(num), 2)
    out.backward(torch.from_numpy(g))
    want = np.array([[[0., 0.], [0., 1.], [1., 1.], [3., 4.], [0., 0.]]])
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), want)
    np.testing.assert_array_equal(tx.grad.numpy(), want)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))


def test_avg_pool_refuses_an_unknown_count_mode():
    feats, parent, num, cap_c, dim = _pool_case(seed=0)
    with pytest.raises(ValueError):
        tpool.avg_pool(torch.from_numpy(feats), torch.from_numpy(parent),
                       torch.from_numpy(num), cap_c, dim, "median")


def test_train_mode_net_matches_reference():
    """A small 3D net in train mode (BN on batch moments; two events):
    output, every parameter's gradient (1e-5 of its leaf's largest) and the
    committed running moments against the reference's."""
    S, dim = 8, 3
    c1, v1, _ = _sparse_blob(S, dim, 70, seed=5)
    c2, v2, _ = _sparse_blob(S, dim, 70, seed=6)
    coords = np.concatenate([c1, c2])
    values = np.concatenate([v1, v2])
    n = np.array([70, 55], np.int32)

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, coords, values, n):
            st, roi = jscn.InputLayer(dim, S)(coords, values, n)
            st = jscn.SubmanifoldConvolution(dim, 4, bias=True)(st)
            st = jscn.BatchNormLeakyReLU(leakiness=0.1)(st, train=True)
            stc, link = jscn.Convolution(dim, 6, bias=True)(st)
            stc = jscn.NetworkInNetwork(6, bias=True)(stc)
            stc = jscn.BatchNormReLU()(stc, train=True)
            stp, plink = jscn.AveragePooling(dim, "active")(stc)
            stc = jscn.add_table(stc, jscn.UnPooling(dim)(stp, plink))
            up = jscn.Deconvolution(dim, 4, bias=True)(stc, link)
            return jscn.OutputLayer(dim)(jscn.join_table(st, up), roi)

    class TNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.conv = scn.SubmanifoldConvolution(dim, 1, 4, bias=True)
            self.bn1 = scn.BatchNormLeakyReLU(4, leakiness=0.1)
            self.down = scn.Convolution(dim, 4, 6, bias=True)
            self.nin = scn.NetworkInNetwork(6, 6, bias=True)
            self.bn2 = scn.BatchNormReLU(6)
            self.pool = scn.AveragePooling(dim, "active")
            self.unpool = scn.UnPooling(dim)
            self.up = scn.Deconvolution(dim, 6, 4, bias=True)
            self.out = scn.OutputLayer(dim)

        def forward(self, coords, values, n):
            st, roi = self.inp(coords, values, n)
            st = self.bn1(self.conv(st), train=True)
            stc, link = self.down(st)
            stc = self.bn2(self.nin(stc), train=True)
            stc = scn.add_table(stc, self.unpool(*self.pool(stc)))
            return self.out(scn.join_table(st, self.up(stc, link)), roi)

    jnet, tnet = JNet(), TNet()
    args = (coords, values, n)
    v = jax.jit(jnet.init)(jax.random.PRNGKey(4), *args)
    # randomized BN affines, so their gradients are not trivial
    v = jax.tree_util.tree_map(
        lambda a: a + 0.3 * np.random.default_rng(a.size).normal(
            size=a.shape).astype(np.float32), v)
    ct = np.random.default_rng(8).normal(size=(2, 70, 8)).astype(np.float32)

    def loss(params):
        out, mut = jnet.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, *args,
                              mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mut["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    load_flax_compact(tnet, v)
    out = tnet(*[torch.from_numpy(a) for a in args])
    (out * torch.from_numpy(ct)).sum().backward()
    commit_batch_moments(tnet)
    _close(out, jout)
    names = _flax_names(tnet, "", "", {})
    params = dict(tnet.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(params)
    for path, want in flat:
        keys = [p.key for p in path]
        name = f"{names['.'.join(keys[:-1])]}.{keys[-1]}"
        _close(params[name].grad, want)
    got_stats = export_variables(tnet)["batch_stats"]
    for path, want in jax.tree_util.tree_flatten_with_path(jstats)[0]:
        keys = [p.key for p in path]
        node = got_stats
        for part in f"{names['.'.join(keys[:-1])]}.{keys[-1]}".split("."):
            node = node[part]
        _close(node, want)


def test_f64_net_sums_in_f64():
    """Layers in f64 (a witness run, as chip_smoke's phase 13 runs one)
    sum in f64: on a full 2D grid the submanifold conv, train-mode BN,
    average pooling and the per-site linear map match their dense f64
    forms to 1e-12 of their largest (f32 sums miss by ~1e-7); and a 3D net
    of the layers in f64 keeps f64 gradients that agree with the f32 net
    from the same parameters to 1e-5 of their largest."""
    S, dim = 8, 2
    coords, values, n = _full_grid_blob(S, dim)
    torch.manual_seed(3)
    conv = scn.SubmanifoldConvolution(dim, 1, 4).double()
    bn = scn.BatchNormLeakyReLU(4, leakiness=0.1).double()
    nin = scn.NetworkInNetwork(4, 3, bias=True).double()
    with torch.no_grad():
        bn.MaskedBatchNorm_0.scale.uniform_(0.5, 1.5)
        bn.MaskedBatchNorm_0.bias.uniform_(-0.5, 0.5)
        nin.b.uniform_(-0.5, 0.5)
    x = torch.from_numpy(values).double()
    st, _ = scn.InputLayer(dim, S)(torch.from_numpy(coords), x,
                                   torch.from_numpy(n))
    st = conv(st)
    dense = F.conv2d(x.view(1, 1, S, S), conv.w.detach().view(
        3, 3, 1, 4).permute(3, 2, 0, 1), padding=1)[0].permute(1, 2, 0)
    _close(st.features.detach()[0], dense.reshape(-1, 4).numpy(), 1e-12)
    st = bn(st, train=True)
    ref = (dense - dense.mean((0, 1))) / torch.sqrt(
        dense.var((0, 1), unbiased=False) + 1e-4)
    ref = ref * bn.MaskedBatchNorm_0.scale.detach() \
        + bn.MaskedBatchNorm_0.bias.detach()
    ref = torch.where(ref >= 0, ref, 0.1 * ref)
    _close(st.features.detach()[0], ref.reshape(-1, 4).numpy(), 1e-12)
    stc, _ = scn.AveragePooling(dim)(st)
    nc = int(stc.num[0])
    ref = ref.view(S // 2, 2, S // 2, 2, 4).mean((1, 3)).reshape(-1, 4)
    _close(stc.features.detach()[0, :nc], ref.numpy(), 1e-12)
    ref = ref @ nin.w.detach()[0] + nin.b.detach()
    _close(nin(stc).features.detach()[0, :nc], ref.numpy(), 1e-12)

    S, dim = 8, 3
    coords, values, n = _sparse_blob(S, dim, 90, seed=9)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.inp = scn.InputLayer(dim, S)
            self.conv = scn.SubmanifoldConvolution(dim, 1, 4)
            self.bn = scn.BatchNormLeakyReLU(4, leakiness=0.1)
            self.down = scn.Convolution(dim, 4, 6)
            self.maxpool = scn.MaxPooling(dim)
            self.avgpool = scn.AveragePooling(dim)
            self.nin = scn.NetworkInNetwork(6, 6, bias=True)
            self.unpool = scn.UnPooling(dim)
            self.up = scn.Deconvolution(dim, 6, 4)
            self.out = scn.OutputLayer(dim)

        def forward(self, coords, values, n):
            st, roi = self.inp(coords, values, n)
            st = self.bn(self.conv(st), train=True)
            stc, link = self.down(st)
            stm, mlink = self.maxpool(stc)
            sta, alink = self.avgpool(stc)
            stc = scn.add_table(self.unpool(stm, mlink),
                                self.unpool(self.nin(sta), alink))
            return self.out(scn.join_table(st, self.up(stc, link)), roi)

    net32 = Net()
    net64 = Net()
    net64.load_state_dict(net32.state_dict())
    net64.double()
    ct = torch.from_numpy(np.random.default_rng(10).normal(size=(1, 90, 8)))
    outs = {}
    for net, dtype in ((net32, torch.float32), (net64, torch.float64)):
        out = net(torch.from_numpy(coords),
                  torch.from_numpy(values).to(dtype), torch.from_numpy(n))
        (out * ct.to(dtype)).sum().backward()
        outs[dtype] = (out, {k: p.grad for k, p in net.named_parameters()})
    out64, g64 = outs[torch.float64]
    out32, g32 = outs[torch.float32]
    assert all(g.dtype == torch.float64 for g in g64.values())
    _close(out32, out64.detach().numpy())
    for k, g in g64.items():
        _close(g32[k], g.numpy())
