"""uresnet_pytorch_tpu_torch — the sparse U-ResNet tile engine in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `uresnet_pytorch_tpu` is the reference this port is held
against. This package imports `torch` and never `jax`, and nothing of the
reference package either: its framework-free modules (`config.py`,
`flags.py`, `iotools/`, `utils/csvdata.py`, `utils/timing.py`, the native
host backend) are its own copies of the reference's.

Layout mirrors the reference so each counterpart is easy to find:
`config.py`, `flags.py`, `iotools/` (loaders, the h5 format, the
prediction writer), `ops/` (keys, halo maps, tile graph, tiled convs),
`ops/cuda/` (kernel wrappers beside their plain torch versions; the CUDA
sources live in `csrc/` and are built on first use), `models/`,
`trainval.py`, `main_funcs.py` (the CLI's loops; the script is
`bin/uresnet_torch.py`) and `utils/` (weights, checkpoints, CSV and
timers, the g++-built host collate).
"""

__version__ = "0.1.0"

from uresnet_pytorch_tpu_torch.config import URESNetConfig  # noqa: F401
