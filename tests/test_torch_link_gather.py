"""The port's tile-link gathers (uresnet_pytorch_tpu_torch/ops/cuda/
windowed_gather.py: `link_assemble`, `link_parent`, the plain versions of
kernel A's two link entry points) against the JAX reference's
`_assemble_impl` / `_parent_corner_impl` (XLA path), bitwise, on the real
links of small graphs built by both packages from the same events; their
gradients through the port's link autograd Functions against `jax.vjp`
of the reference's; and the stacked maps kernel A reads against the
per-octant specs they are built from."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.config import URESNetConfig
from uresnet_pytorch_tpu.iotools.synthetic import generate_event
from uresnet_pytorch_tpu.ops import tile_conv as jtc
from uresnet_pytorch_tpu.ops import tile_graph as jtg
from uresnet_pytorch_tpu_torch.config import URESNetConfig as TConfig
from uresnet_pytorch_tpu_torch.ops import tile_conv as ttc
from uresnet_pytorch_tpu_torch.ops import tile_graph as ttg
from uresnet_pytorch_tpu_torch.ops.cuda import windowed_gather as wg
from tests.test_torch_model import one_torch_thread  # noqa: F401

# (dim, spatial size, tile schedule): a global t=4 graph links t_c=4
# tiles, the halving schedule an identity link and then t_c=2 links
GRAPHS = {"3d t_c=4": (3, 32, None), "3d t_c=2": (3, 32, (4, 2, 2)),
          "2d t_c=4": (2, 64, None), "2d t_c=2": (2, 64, (4, 2, 2))}


@functools.lru_cache(maxsize=None)
def _graphs(kind):
    """(reference graph, port graph) of the same events."""
    dim, S, tiles = GRAPHS[kind]
    kw = dict(num_class=5, uresnet_filters=4, uresnet_num_strides=3,
              spatial_size=S, data_dim=dim, reps=1, max_voxels=512,
              min_level_capacity=32, compute_dtype="float32", tile_size=4,
              tile_sizes=tiles, min_tiles=32)
    cfg, tcfg = URESNetConfig(**kw), TConfig(**kw)
    B = 2
    coords = np.zeros((B, cfg.max_voxels, dim), np.int32)
    values = np.zeros((B, cfg.max_voxels), np.float32)
    nv = np.zeros((B,), np.int32)
    for b in range(B):
        c, v, _ = generate_event(3, b, S, dim, 300)
        n = min(len(c), cfg.max_voxels)
        coords[b, :n], values[b, :n], nv[b] = c[:n], v[:n], n
    ref = jax.jit(lambda c, v, n: jtg.build_tile_graph(c, v, n, cfg))(
        coords, values, nv)
    assert int(jtg.graph_overflows(ref)) == 0
    port = ttg.build_tile_graph(torch.from_numpy(coords),
                                torch.from_numpy(values),
                                torch.from_numpy(nv), tcfg)
    return ref, port, tcfg


def _real_links(kind):
    """(level, t_c, reference link, port link) of every real link."""
    ref, port, tcfg = _graphs(kind)
    out = [(l, ttg.tile_size_at(tcfg, l + 1), rl, pl)
           for l, (rl, pl) in enumerate(zip(ref.links, port.links))
           if len(pl.children) > 1]
    assert out, "the graph has no real link"
    return out


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _to_jax(a, dtype):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if dtype == torch.bfloat16 else x


def _eq(port, ref, what):
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)),
                                  err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 7, 48])
@pytest.mark.parametrize("kind", list(GRAPHS))
def test_plain_links_match_reference(kind, C, dtype):
    """Both directions, bitwise, at every real link of the graph."""
    dim = GRAPHS[kind][0]
    rng = np.random.default_rng(C)
    for l, t_c, rl, pl in _real_links(kind):
        th = t_c // 2
        Tf, Tc = pl.idx2.shape[1], pl.cidx.shape[2]
        blocks = rng.standard_normal((2, Tf, th ** dim, C), dtype=np.float32)
        xc = rng.standard_normal((2, Tc, t_c ** dim, C), dtype=np.float32)
        got = wg.link_assemble(_to_torch(blocks, dtype), pl, t_c, dim)
        assert got.shape == (2, Tc, t_c ** dim, C) and got.dtype == dtype
        _eq(got, jtc._assemble_impl(_to_jax(blocks, dtype), rl.children,
                                    t_c, dim), f"link {l} assemble")
        got = wg.link_parent(_to_torch(xc, dtype), pl, t_c, dim)
        assert got.shape == (2, Tf, th ** dim, C) and got.dtype == dtype
        _eq(got, jtc._parent_corner_impl(_to_jax(xc, dtype), rl, t_c, dim),
            f"link {l} parent")


@pytest.mark.parametrize("direction", ["assemble", "parent"])
@pytest.mark.parametrize("kind", list(GRAPHS))
def test_link_gradients_match_reference_vjp(kind, direction):
    """The port's link Functions (each the other's transpose) against
    jax.vjp of the reference's custom-VJP link ops: values and gradients,
    bitwise (both only move values)."""
    dim = GRAPHS[kind][0]
    rng = np.random.default_rng(7)
    C = 5
    for l, t_c, rl, pl in _real_links(kind):
        th = t_c // 2
        Tf, Tc = pl.idx2.shape[1], pl.cidx.shape[2]
        fine, coarse = (2, Tf, th ** dim, C), (2, Tc, t_c ** dim, C)
        if direction == "assemble":
            shape_in, shape_out = fine, coarse
            fn, jfn = ttc._AssembleChildrenLink, jtc.assemble_children_link
        else:
            shape_in, shape_out = coarse, fine
            fn, jfn = ttc._ParentCornerLink, jtc.parent_corner_link
        x = rng.standard_normal(shape_in, dtype=np.float32)
        g = rng.standard_normal(shape_out, dtype=np.float32)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = fn.apply(xt, pl, t_c, dim)
        out.backward(torch.from_numpy(g))
        ref_out, vjp = jax.vjp(lambda a: jfn(a, rl, t_c, dim), jnp.asarray(x))
        (ref_grad,) = vjp(jnp.asarray(g))
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(ref_out),
                                      err_msg=f"link {l} {direction}")
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_grad),
                                      err_msg=f"link {l} {direction} grad")


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_stacked_link_maps_match_octant_specs(kind):
    """`cidx`/`cok` stack the children specs, `idx2` is the parents'
    shared idx and `pok` the union of their disjoint oks; an identity link
    carries no stacked maps."""
    _, port, _ = _graphs(kind)
    for l, link in enumerate(port.links):
        if len(link.children) == 1:
            assert (link.cidx, link.cok, link.idx2, link.pok) == (None,) * 4
            continue
        noct = len(link.children)
        assert link.cidx.shape == (2, noct, link.children[0].idx.shape[1])
        assert link.cidx.dtype == torch.int32 and link.idx2.dtype == \
            torch.int32
        for o, (c, p) in enumerate(zip(link.children, link.parents)):
            assert torch.equal(link.cidx[:, o], c.idx), (l, o)
            assert torch.equal(link.cok[:, o], c.ok), (l, o)
            assert torch.equal(link.idx2, p.idx), (l, o)
            # the octant a live fine tile occupies is the low bits of idx2
            assert torch.equal(p.ok, link.pok & (link.idx2 % noct == o))
        oks = torch.stack([p.ok for p in link.parents]).int()
        assert int(oks.sum(0).max()) <= 1, "parent specs overlap"
        assert torch.equal(oks.sum(0) > 0, link.pok)
        assert bool(link.pok.any()) and bool(link.cok.any())


def test_link_wrappers_raise_off_cpu_and_cuda():
    """No fallback: on a device that is neither the CPU nor CUDA the
    wrappers raise rather than run the plain version."""
    _, port, _ = _graphs("3d t_c=2")
    link = next(pl for pl in port.links if len(pl.children) > 1)
    Tf, Tc = link.idx2.shape[1], link.cidx.shape[2]
    with pytest.raises(ValueError, match="unsupported device"):
        wg.link_assemble(torch.zeros(2, Tf, 1, 4, device="meta"), link, 2, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        wg.link_parent(torch.zeros(2, Tc, 8, 4, device="meta"), link, 2, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        wg.windowed_gather(torch.zeros(2, Tf, 4, device="meta"),
                           link.idx2, link.pok)
