"""The port's row gather (plain torch version of kernel A,
uresnet_pytorch_tpu_torch/ops/cuda/windowed_gather.py) against the JAX
reference's windowed gather, bitwise, on a spec whose windows miss some
pairs: the reference serves those through its correction list, the port
through the same full (idx, ok) it keeps for every row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uresnet_pytorch_tpu.ops import tile_conv as jtc
from uresnet_pytorch_tpu.ops.pallas.windowed_gather import gather_forward
from uresnet_pytorch_tpu.ops.tile_graph import make_gather_spec
from uresnet_pytorch_tpu_torch.ops.cuda import windowed_gather as wg
from uresnet_pytorch_tpu_torch.ops.tile_graph import GatherSpec
from tests.test_torch_model import one_torch_thread  # noqa: F401


def _spec(seed, B=2, S=96, N=64):
    """Near-monotone rows with far jumps (out of window) and invalid rows."""
    rng = np.random.default_rng(seed)
    base = np.clip(np.arange(N) * (S // N) + rng.integers(-4, 5, N), 0, S - 1)
    far = rng.random((B, N)) < 0.1
    idx = np.where(far, rng.integers(0, S, (B, N)), base[None])
    idx = idx.astype(np.int32)
    ok = rng.random((B, N)) < 0.9
    jspec = jax.vmap(lambda i, o: make_gather_spec(i, o, S, 16))(
        jnp.asarray(idx), jnp.asarray(ok))
    assert int(np.asarray(jspec.corr_ok).sum()) > 0      # corrections used
    assert int(np.asarray(jspec.overflow).sum()) == 0
    return jspec, GatherSpec(torch.from_numpy(idx), torch.from_numpy(ok))


def test_plain_gather_matches_pallas_interpret_and_xla():
    jspec, spec = _spec(9)
    src = np.random.default_rng(1).normal(size=(2, 96, 128)).astype(
        np.float32)
    port = wg.windowed_gather(torch.from_numpy(src), spec.idx,
                              spec.ok).numpy()
    np.testing.assert_array_equal(
        port, np.asarray(gather_forward(jnp.asarray(src), jspec,
                                        interpret=True)))
    np.testing.assert_array_equal(
        port, np.asarray(jtc._windowed_gather_xla(jnp.asarray(src), jspec)))


@pytest.mark.parametrize("F", [1, 48, 7])
def test_plain_gather_bf16_matches_xla(F):
    """bf16 rows of the widths the main path moves (occupancy: 1; corner
    views of level-1 features: 48) and an odd width."""
    jspec, spec = _spec(F)
    src = np.random.default_rng(F).normal(size=(2, 96, F)).astype(np.float32)
    port = wg.windowed_gather(torch.from_numpy(src).to(torch.bfloat16),
                              spec.idx, spec.ok)
    ref = jtc._windowed_gather_xla(jnp.asarray(src).astype(jnp.bfloat16),
                                   jspec)
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_gather_out_of_range_rows_read_zero():
    """Indices beyond the source read as zeros, in both versions."""
    src = torch.arange(12.0).reshape(1, 4, 3)
    idx = torch.tensor([[3, 9, -1, 0]], dtype=torch.int32)
    ok = torch.tensor([[True, True, True, False]])
    out = wg.windowed_gather(src, idx, ok)
    np.testing.assert_array_equal(out[0, 0].numpy(), [9.0, 10.0, 11.0])
    assert (out[0, 1:] == 0).all()
