"""uresnet_pytorch_tpu_torch — the sparse U-ResNet tile engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `uresnet_pytorch_tpu` is the reference this port is held
against. This package imports `torch` and never `jax`, and nothing of the
reference package either: `config.py` and `iotools/synthetic.py` are its
own ports of the reference's configuration and event generator.

Layout mirrors the reference so each counterpart is easy to find:
`config.py`, `iotools/`, `ops/` (keys, halo maps, tile graph, tiled convs),
`ops/cuda/` (kernel wrappers beside their plain torch versions; the CUDA
sources live in `csrc/` and are built on first use), `models/`,
`trainval.py` and `utils/weights.py`.
"""

__version__ = "0.1.0"

from uresnet_pytorch_tpu_torch.config import URESNetConfig  # noqa: F401
